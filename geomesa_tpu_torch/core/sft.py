"""SimpleFeatureType: named, typed attribute schemas with spec-string syntax.

Parity: org.locationtech.geomesa.utils.geotools.SimpleFeatureTypes
(geomesa-utils) [upstream, unverified]. The spec-string grammar is preserved:

    "name:String:index=true,dtg:Date,*geom:Point:srid=4326"

- comma-separated attributes, each `name:Type[:opt=value]*`
- a leading `*` marks the default geometry attribute
- recognized types: String, Integer/Int, Long, Double, Float, Boolean,
  Date, Timestamp, UUID, Bytes, Point, LineString, Polygon, MultiPoint,
  MultiLineString, MultiPolygon, GeometryCollection, Geometry,
  List[T], Map[K,V]
- per-attribute options (index=..., srid=..., cardinality=...) are kept as
  opaque string key/values, as upstream does with user data.

Type-level user data can be appended after a ';' as key=value pairs
(e.g. ";geomesa.z3.interval=week"), mirroring upstream's SFT user data that
configures index intervals, sharding, and visibility.

A copy of the reference package's `core/sft.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

GEOMETRY_TYPES = {
    "Point",
    "LineString",
    "Polygon",
    "MultiPoint",
    "MultiLineString",
    "MultiPolygon",
    "GeometryCollection",
    "Geometry",
}

_TYPE_ALIASES = {
    "int": "Integer",
    "integer": "Integer",
    "long": "Long",
    "double": "Double",
    "float": "Float",
    "string": "String",
    "boolean": "Boolean",
    "bool": "Boolean",
    "date": "Date",
    "timestamp": "Timestamp",
    "uuid": "UUID",
    "bytes": "Bytes",
}

# Canonical attribute types and their columnar physical layout.
PHYSICAL = {
    "String": "dictionary<int32>",
    "Integer": "int32",
    "Long": "int64",
    "Double": "float64",
    "Float": "float32",
    "Boolean": "bool",
    "Date": "int64",  # epoch millis
    "Timestamp": "int64",  # epoch millis
    "UUID": "dictionary<int32>",
    "Bytes": "binary",
}


def _canonical_type(t: str) -> str:
    t = t.strip()
    if t.startswith("List[") or t.startswith("Map["):
        return t
    if t in GEOMETRY_TYPES:
        return t
    low = t.lower()
    if low in _TYPE_ALIASES:
        return _TYPE_ALIASES[low]
    if t in PHYSICAL:
        return t
    raise ValueError(f"unknown attribute type: {t!r}")


@dataclasses.dataclass
class AttributeDescriptor:
    name: str
    type: str
    default_geom: bool = False
    options: Dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def is_geometry(self) -> bool:
        base = self.type.split("[")[0]
        return base in GEOMETRY_TYPES

    @property
    def is_temporal(self) -> bool:
        return self.type in ("Date", "Timestamp")

    def to_spec(self) -> str:
        parts = [f"{'*' if self.default_geom else ''}{self.name}:{self.type}"]
        for k, v in self.options.items():
            parts.append(f"{k}={v}")
        return ":".join(parts)


@dataclasses.dataclass
class SimpleFeatureType:
    name: str
    attributes: List[AttributeDescriptor]
    user_data: Dict[str, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self._by_name = {a.name: a for a in self.attributes}
        if len(self._by_name) != len(self.attributes):
            raise ValueError("duplicate attribute names")

    # -- accessors ---------------------------------------------------------

    def attribute(self, name: str) -> AttributeDescriptor:
        return self._by_name[name]

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def index_of(self, name: str) -> int:
        for i, a in enumerate(self.attributes):
            if a.name == name:
                return i
        raise KeyError(name)

    @property
    def attribute_names(self) -> List[str]:
        return [a.name for a in self.attributes]

    @property
    def default_geometry(self) -> Optional[AttributeDescriptor]:
        for a in self.attributes:
            if a.default_geom:
                return a
        for a in self.attributes:
            if a.is_geometry:
                return a
        return None

    @property
    def default_dtg(self) -> Optional[AttributeDescriptor]:
        """The default date attribute, honoring the geomesa.index.dtg user-data
        override as upstream does."""
        override = self.user_data.get("geomesa.index.dtg")
        if override and override in self:
            return self.attribute(override)
        for a in self.attributes:
            if a.is_temporal:
                return a
        return None

    # -- spec string -------------------------------------------------------

    @classmethod
    def from_spec(cls, name: str, spec: str) -> "SimpleFeatureType":
        spec = spec.strip()
        user_data: Dict[str, str] = {}
        if ";" in spec:
            spec, ud = spec.split(";", 1)
            for pair in ud.split(","):
                pair = pair.strip()
                if pair:
                    k, _, v = pair.partition("=")
                    user_data[k.strip()] = v.strip()
        attrs: List[AttributeDescriptor] = []
        for field in _split_top_level(spec, ","):
            field = field.strip()
            if not field:
                continue
            default_geom = field.startswith("*")
            if default_geom:
                field = field[1:]
            parts = _split_top_level(field, ":")
            if len(parts) < 2:
                raise ValueError(f"bad attribute spec: {field!r}")
            attr_name, attr_type = parts[0].strip(), _canonical_type(parts[1])
            options: Dict[str, str] = {}
            for opt in parts[2:]:
                k, _, v = opt.partition("=")
                options[k.strip()] = v.strip()
            attrs.append(AttributeDescriptor(attr_name, attr_type, default_geom, options))
        return cls(name, attrs, user_data)

    def to_spec(self) -> str:
        body = ",".join(a.to_spec() for a in self.attributes)
        if self.user_data:
            body += ";" + ",".join(f"{k}={v}" for k, v in self.user_data.items())
        return body


def _split_top_level(s: str, sep: str) -> List[str]:
    """Split on sep, ignoring separators inside [] (List[..], Map[..,..])."""
    out, depth, cur = [], 0, []
    for ch in s:
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        if ch == sep and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return out
