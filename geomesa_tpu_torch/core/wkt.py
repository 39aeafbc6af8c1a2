"""Minimal WKT/host geometry model.

Parity: the WKTUtils/WKBUtils role in geomesa-utils [upstream, unverified] —
the reference leans on JTS for geometry objects; here the host-side model is a
tiny tagged union over NumPy coordinate arrays, because the device-side model
(see core.columnar.GeometryColumn) is columnar CSR, not object-per-feature.

Supported: POINT, LINESTRING, POLYGON (with holes), MULTIPOINT,
MULTILINESTRING, MULTIPOLYGON, GEOMETRYCOLLECTION (parse only), EMPTY forms.

A copy of the reference package's `core/wkt.py`: parse and render WKT, the
GeoJSON geometry object and ISO WKB.
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


# The canonical text `to_wkt` writes for a polygon (every number matched
# whole by the token rule, a single space between x and y, ", " between
# points and rings): such text parses to the same Geometry as `_Parser`
# gives (nothing to skip, no Z/M ordinates), but with one C-level scan and
# one float conversion per ring instead of a Python step per token. Any
# other text takes `_Parser`.
_NUM = r"-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?"
_PAIR = f"{_NUM} {_NUM}"
_RING = rf"\({_PAIR}(?:, {_PAIR})*\)"
_CANONICAL_POLYGON = re.compile(rf"POLYGON \({_RING}(?:, {_RING})*\)")


def parse_wkt(text: str) -> Geometry:
    if text.startswith("POLYGON ((") and _CANONICAL_POLYGON.fullmatch(text):
        rings = [np.array(r.replace(",", "").split(), np.float64).reshape(-1, 2)
                 for r in text[10:-2].split("), (")]
        return Geometry("Polygon", rings)
    return _Parser(text).geometry()


def to_wkt(g: Geometry) -> str:
    def num(v: float) -> str:
        # shortest exact representation (repr round-trips float64)
        return repr(float(v))

    def ring(r: np.ndarray) -> str:
        a = np.asarray(r, np.float64)
        if a.ndim != 2 or a.shape[1] != 2:
            return "(" + ", ".join(f"{num(x)} {num(y)}" for x, y in r) + ")"
        # the same text as the per-pair loop, joined at C speed: repr of
        # each f64 as a Python float, pairs joined by a space
        it = iter(list(map(repr, a.ravel().tolist())))
        return "(" + ", ".join(map(" ".join, zip(it, it))) + ")"

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


def to_geojson(g: Geometry) -> dict:
    """GeoJSON geometry object; Geometry.parts groups MultiPolygon rings."""

    def ring(r) -> list:
        return np.asarray(r, np.float64).tolist()

    if g.kind == "Point":
        x, y = g.point
        return {"type": "Point", "coordinates": [float(x), float(y)]}
    if g.kind == "MultiPoint":
        pts = np.concatenate([np.asarray(r, np.float64) for r in g.rings], axis=0)
        return {"type": "MultiPoint", "coordinates": pts.tolist()}
    if g.kind == "LineString" and len(g.rings) == 1:
        return {"type": "LineString", "coordinates": ring(g.rings[0])}
    if g.kind in ("MultiLineString", "LineString"):
        return {"type": "MultiLineString", "coordinates": [ring(r) for r in g.rings]}
    if g.kind == "Polygon":
        return {"type": "Polygon", "coordinates": [ring(r) for r in g.rings]}
    if g.kind == "MultiPolygon":
        polys, i = [], 0
        for n in g.parts:
            polys.append([ring(r) for r in g.rings[i : i + n]])
            i += n
        return {"type": "MultiPolygon", "coordinates": polys}
    # GeometryCollection-ish fallback: emit each part as a polygon ring list
    return {"type": "MultiLineString", "coordinates": [ring(r) for r in g.rings]}


# -- WKB ---------------------------------------------------------------------
# ISO WKB, little-endian, 2-D (the WKBUtils role: geomesa-utils
# o.l.g.utils.text.WKBUtils [upstream, unverified]).

import struct as _struct

_WKB_KIND = {
    "Point": 1, "LineString": 2, "Polygon": 3,
    "MultiPoint": 4, "MultiLineString": 5, "MultiPolygon": 6,
}
_WKB_NAME = {v: k for k, v in _WKB_KIND.items()}


def to_wkb(g: Geometry) -> bytes:
    """Encode little-endian ISO WKB."""
    out = bytearray()

    def header(kind_code: int):
        out.append(1)  # little-endian
        out.extend(_struct.pack("<I", kind_code))

    def ring(r: np.ndarray):
        out.extend(_struct.pack("<I", len(r)))
        out.extend(np.ascontiguousarray(r, "<f8").tobytes())

    k = g.kind
    header(_WKB_KIND[k])
    if k == "Point":
        x, y = g.point
        out.extend(_struct.pack("<dd", float(x), float(y)))
    elif k == "LineString":
        ring(g.rings[0])
    elif k == "Polygon":
        out.extend(_struct.pack("<I", len(g.rings)))
        for r in g.rings:
            ring(r)
    elif k == "MultiPoint":
        pts = np.concatenate([np.asarray(r, np.float64) for r in g.rings], 0)
        out.extend(_struct.pack("<I", len(pts)))
        for x, y in pts:
            header(1)
            out.extend(_struct.pack("<dd", float(x), float(y)))
    elif k == "MultiLineString":
        out.extend(_struct.pack("<I", len(g.rings)))
        for r in g.rings:
            header(2)
            ring(r)
    elif k == "MultiPolygon":
        out.extend(_struct.pack("<I", len(g.parts)))
        i = 0
        for n in g.parts:
            header(3)
            out.extend(_struct.pack("<I", n))
            for r in g.rings[i: i + n]:
                ring(r)
            i += n
    else:
        raise ValueError(f"cannot WKB-encode {k}")
    return bytes(out)


def parse_wkb(buf: bytes) -> Geometry:
    """Decode (a prefix of) WKB; both byte orders accepted."""
    pos = [0]

    def take(n):
        s = buf[pos[0]: pos[0] + n]
        if len(s) < n:
            raise ValueError("truncated WKB")
        pos[0] += n
        return s

    def geometry() -> Geometry:
        bo = "<" if take(1)[0] == 1 else ">"
        code = _struct.unpack(bo + "I", take(4))[0]
        if code > 1000:
            # Z/M/ZM variants change the per-point stride; reading them
            # as 2-D would silently produce garbage coordinates
            raise ValueError(
                f"WKB geometry code {code}: Z/M dimensions unsupported"
            )
        kind = _WKB_NAME.get(code)
        if kind is None:
            raise ValueError(f"unsupported WKB geometry code {code}")

        def ring():
            n = _struct.unpack(bo + "I", take(4))[0]
            return np.frombuffer(
                take(16 * n), dtype=bo + "f8"
            ).reshape(n, 2).astype(np.float64)

        if kind == "Point":
            x, y = _struct.unpack(bo + "dd", take(16))
            return point(x, y)
        if kind == "LineString":
            return Geometry("LineString", [ring()])
        if kind == "Polygon":
            n = _struct.unpack(bo + "I", take(4))[0]
            return Geometry("Polygon", [ring() for _ in range(n)])
        n = _struct.unpack(bo + "I", take(4))[0]
        subs = [geometry() for _ in range(n)]
        if kind == "MultiPoint":
            pts = np.concatenate([s.rings[0] for s in subs], 0)
            return Geometry("MultiPoint", [pts[i:i + 1] for i in range(len(pts))])
        if kind == "MultiLineString":
            return Geometry("MultiLineString", [s.rings[0] for s in subs])
        rings: List[np.ndarray] = []
        parts: List[int] = []
        for s in subs:
            rings.extend(s.rings)
            parts.append(len(s.rings))
        return Geometry("MultiPolygon", rings, parts)

    return geometry()
