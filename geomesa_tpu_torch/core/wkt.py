"""Minimal WKT/host geometry model.

Parity: the WKTUtils/WKBUtils role in geomesa-utils [upstream, unverified] —
the reference leans on JTS for geometry objects; here the host-side model is a
tiny tagged union over NumPy coordinate arrays, because the device-side model
(see core.columnar.GeometryColumn) is columnar CSR, not object-per-feature.

Supported: POINT, LINESTRING, POLYGON (with holes), MULTIPOINT,
MULTILINESTRING, MULTIPOLYGON, GEOMETRYCOLLECTION (parse only), EMPTY forms.

A copy of the reference package's `core/wkt.py` (parse and WKT render; the
GeoJSON and WKB codecs are not needed by this package yet).
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class Geometry:
    """Host geometry: `kind` + rings.

    rings: list of (M, 2) float64 arrays.
      - POINT: one ring of length 1
      - LINESTRING: one ring (the path)
      - POLYGON: first ring = shell, rest = holes
      - MULTI*: `parts` gives the ring-count per part
    """

    kind: str
    rings: List[np.ndarray]
    parts: List[int] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if not self.parts:
            self.parts = [len(self.rings)]

    def __eq__(self, other):
        if not isinstance(other, Geometry):
            return NotImplemented
        return (
            self.kind == other.kind
            and self.parts == other.parts
            and len(self.rings) == len(other.rings)
            and all(np.array_equal(a, b) for a, b in zip(self.rings, other.rings))
        )

    @property
    def bbox(self) -> Tuple[float, float, float, float]:
        if not self.rings:
            return (np.nan, np.nan, np.nan, np.nan)
        allv = np.concatenate(self.rings, axis=0)
        return (
            float(allv[:, 0].min()),
            float(allv[:, 1].min()),
            float(allv[:, 0].max()),
            float(allv[:, 1].max()),
        )

    @property
    def is_point(self) -> bool:
        return self.kind == "Point"

    @property
    def point(self) -> Tuple[float, float]:
        v = self.rings[0][0]
        return float(v[0]), float(v[1])


def point(x: float, y: float) -> Geometry:
    return Geometry("Point", [np.array([[x, y]], dtype=np.float64)])


def box(xmin: float, ymin: float, xmax: float, ymax: float) -> Geometry:
    shell = np.array(
        [[xmin, ymin], [xmax, ymin], [xmax, ymax], [xmin, ymax], [xmin, ymin]],
        dtype=np.float64,
    )
    return Geometry("Polygon", [shell])


_TOKEN = re.compile(r"[A-Za-z]+|\(|\)|,|-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?")


class _Parser:
    def __init__(self, text: str):
        self.tokens = _TOKEN.findall(text)
        self.pos = 0

    def peek(self) -> str:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else ""

    def next(self) -> str:
        t = self.peek()
        self.pos += 1
        return t

    def expect(self, t: str):
        got = self.next()
        if got != t:
            raise ValueError(f"WKT parse error: expected {t!r}, got {got!r}")

    def coords(self) -> np.ndarray:
        """( x y, x y, ... )"""
        self.expect("(")
        pts = []
        while True:
            x = float(self.next())
            y = float(self.next())
            # tolerate Z/M ordinates by skipping extra numbers
            while re.fullmatch(r"-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?", self.peek() or "x"):
                self.next()
            pts.append((x, y))
            t = self.next()
            if t == ")":
                break
            if t != ",":
                raise ValueError(f"WKT parse error at {t!r}")
        return np.array(pts, dtype=np.float64)

    def ring_list(self) -> List[np.ndarray]:
        """( (ring), (ring), ... )"""
        self.expect("(")
        rings = []
        while True:
            rings.append(self.coords())
            t = self.next()
            if t == ")":
                break
            if t != ",":
                raise ValueError(f"WKT parse error at {t!r}")
        return rings

    def geometry(self) -> Geometry:
        kind = self.next().upper()
        if self.peek().upper() in ("Z", "M", "ZM"):
            self.next()  # dimension tag; extra ordinates are skipped in coords()
        if self.peek().upper() == "EMPTY":
            self.next()
            return Geometry(_KINDS[kind], [], parts=[0])
        if kind == "POINT":
            c = self.coords()
            return Geometry("Point", [c[:1]])
        if kind == "LINESTRING":
            return Geometry("LineString", [self.coords()])
        if kind == "POLYGON":
            return Geometry("Polygon", self.ring_list())
        if kind == "MULTIPOINT":
            # both MULTIPOINT(1 2, 3 4) and MULTIPOINT((1 2),(3 4))
            self.expect("(")
            rings = []
            while True:
                if self.peek() == "(":
                    self.next()
                    x, y = float(self.next()), float(self.next())
                    self.expect(")")
                else:
                    x, y = float(self.next()), float(self.next())
                rings.append(np.array([[x, y]], dtype=np.float64))
                t = self.next()
                if t == ")":
                    break
            return Geometry("MultiPoint", rings, parts=[1] * len(rings))
        if kind == "MULTILINESTRING":
            rings = self.ring_list()
            return Geometry("MultiLineString", rings, parts=[1] * len(rings))
        if kind == "MULTIPOLYGON":
            self.expect("(")
            rings: List[np.ndarray] = []
            parts: List[int] = []
            while True:
                poly = self.ring_list()
                rings.extend(poly)
                parts.append(len(poly))
                t = self.next()
                if t == ")":
                    break
            return Geometry("MultiPolygon", rings, parts=parts)
        if kind == "GEOMETRYCOLLECTION":
            # flatten: keep rings of all members; kind reflects collection
            self.expect("(")
            rings, parts = [], []
            while True:
                g = self.geometry()
                rings.extend(g.rings)
                parts.extend(g.parts)
                t = self.next()
                if t == ")":
                    break
            return Geometry("GeometryCollection", rings, parts)
        raise ValueError(f"unsupported WKT kind {kind!r}")


_KINDS = {
    "POINT": "Point",
    "LINESTRING": "LineString",
    "POLYGON": "Polygon",
    "MULTIPOINT": "MultiPoint",
    "MULTILINESTRING": "MultiLineString",
    "MULTIPOLYGON": "MultiPolygon",
    "GEOMETRYCOLLECTION": "GeometryCollection",
}


def parse_wkt(text: str) -> Geometry:
    return _Parser(text).geometry()


def to_wkt(g: Geometry) -> str:
    def num(v: float) -> str:
        # shortest exact representation (repr round-trips float64)
        return repr(float(v))

    def ring(r: np.ndarray) -> str:
        return "(" + ", ".join(f"{num(x)} {num(y)}" for x, y in r) + ")"

    if g.kind == "Point":
        x, y = g.point
        return f"POINT ({num(x)} {num(y)})"
    if g.kind == "LineString":
        return "LINESTRING " + ring(g.rings[0])
    if g.kind == "Polygon":
        return "POLYGON (" + ", ".join(ring(r) for r in g.rings) + ")"
    if g.kind == "MultiPoint":
        return "MULTIPOINT (" + ", ".join(ring(r)[1:-1] for r in g.rings) + ")"
    if g.kind == "MultiLineString":
        return "MULTILINESTRING (" + ", ".join(ring(r) for r in g.rings) + ")"
    if g.kind == "MultiPolygon":
        out, i = [], 0
        for n in g.parts:
            out.append("(" + ", ".join(ring(r) for r in g.rings[i : i + n]) + ")")
            i += n
        return "MULTIPOLYGON (" + ", ".join(out) + ")"
    raise ValueError(f"cannot encode {g.kind}")
