"""Index keyspaces: row-key schemas + query-range generators.

Parity: geomesa-index-api's index catalog (SURVEY.md C7) [upstream,
unverified]:

  Z3  [shard][2B epoch bin][8B z3][fid]     points + time (the default)
  Z2  [shard][8B z2][fid]                   points, no time
  XZ3 [shard][2B epoch bin][8B xz3][fid]    extended geometries + time
  XZ2 [shard][8B xz2][fid]                  extended geometries
  ID  [fid]                                 primary-key lookup
  ATTR [2B attr idx][lexicoded value][0x00][8B z3-tier suffix][fid]

Shards are hash-mod write-spreading bytes (upstream ShardStrategy). Range
generation returns *covering* byte ranges — false positives are removed by
the residual compiled-predicate mask downstream, exactly the role of the
reference's Z3Iterator/server-side residual filter.

A copy of the reference package's `index/keyspace.py`: keys and
ranges are byte for byte the reference's.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from geomesa_tpu_torch.core.columnar import DictColumn, FeatureBatch, GeometryColumn
from geomesa_tpu_torch.core.sft import SimpleFeatureType
from geomesa_tpu_torch.cql import ast
from geomesa_tpu_torch.cql.extract import extract_bbox, extract_intervals
from geomesa_tpu_torch.curve.binned_time import TimePeriod
from geomesa_tpu_torch.curve.xz import XZ2SFC, XZ3SFC
from geomesa_tpu_torch.curve.z2 import Z2SFC
from geomesa_tpu_torch.curve.z3 import Z3SFC
from geomesa_tpu_torch.index import lexicoders as lx

# An inclusive-lower / exclusive-upper byte-key range.
ByteRange = Tuple[bytes, bytes]

UNBOUNDED_MILLIS = (-(1 << 50), 1 << 50)


def _shard_of(fid: str, shards: int) -> int:
    return zlib.crc32(fid.encode("utf-8")) % shards


@dataclasses.dataclass
class WriteKey:
    """One index entry for one feature."""

    key: bytes
    row: int  # storage row id


class IndexKeySpace:
    """SPI: key schema + range generation for one index type."""

    name: str = "?"

    def __init__(self, sft: SimpleFeatureType, shards: int = 4):
        self.sft = sft
        self.shards = max(1, shards)

    # -- writes ------------------------------------------------------------

    def write_keys(
        self, batch: FeatureBatch, fids: Sequence[str], rows: Sequence[int]
    ) -> List[WriteKey]:
        raise NotImplementedError

    # -- reads -------------------------------------------------------------

    def supports(self, f: ast.Filter) -> bool:
        """Can this index produce bounded ranges for the filter?"""
        raise NotImplementedError

    def ranges(self, f: ast.Filter, max_ranges: int = 512) -> List[ByteRange]:
        raise NotImplementedError

    # -- helpers -----------------------------------------------------------

    def _geom(self) -> str:
        g = self.sft.default_geometry
        if g is None:
            raise ValueError(f"{self.name}: schema has no geometry")
        return g.name

    def _dtg(self) -> str:
        d = self.sft.default_dtg
        if d is None:
            raise ValueError(f"{self.name}: schema has no dtg")
        return d.name

    def _shard_ranges(self, inner: Iterable[Tuple[bytes, bytes]]) -> List[ByteRange]:
        """Cross each inner (lo, hi_exclusive) with every shard prefix."""
        inner = list(inner)
        out = []
        for s in range(self.shards):
            p = bytes([s])
            for lo, hi in inner:
                out.append((p + lo, p + hi))
        return out


class Z3Index(IndexKeySpace):
    name = "z3"

    def __init__(
        self,
        sft: SimpleFeatureType,
        shards: int = 4,
        period: "str | TimePeriod" = TimePeriod.WEEK,
    ):
        super().__init__(sft, shards)
        self.sfc = Z3SFC(period)

    def write_keys(self, batch, fids, rows):
        g, d = self._geom(), self._dtg()
        col: GeometryColumn = batch.columns[g]
        dtg = np.asarray(batch.columns[d], np.int64)
        bins, zs = self.sfc.index(col.x, col.y, dtg)
        out = []
        for i in range(len(batch)):
            shard = _shard_of(fids[i], self.shards)
            key = (
                bytes([shard])
                + struct.pack(">H", int(bins[i]) & 0xFFFF)
                + struct.pack(">Q", int(zs[i]))
                + fids[i].encode("utf-8")
            )
            out.append(WriteKey(key, rows[i]))
        return out

    def supports(self, f):
        # z3/xz3 need a fully bounded time range (upstream: the z3 index
        # requires a during/between-style interval; open-ended predicates
        # fall back to the spatial-only index or a full scan)
        interval = extract_intervals(f, self._dtg())
        return (
            interval.start is not None
            and interval.end is not None
            and not interval.is_empty
        )

    def ranges(self, f, max_ranges=512):
        bbox = extract_bbox(f, self._geom())
        interval = extract_intervals(f, self._dtg())
        if bbox.is_empty or interval.is_empty:
            return []
        per_bin = self.sfc.ranges(
            bbox.xmin, bbox.ymin, bbox.xmax, bbox.ymax,
            int(interval.start), int(interval.end),
            max_ranges=max_ranges,
        )
        inner = []
        for b, rs in per_bin.items():
            prefix = struct.pack(">H", int(b) & 0xFFFF)
            for r in rs:
                inner.append(
                    (prefix + struct.pack(">Q", r.lower),
                     prefix + struct.pack(">Q", r.upper + 1))
                )
        return self._shard_ranges(inner)


class Z2Index(IndexKeySpace):
    name = "z2"

    def __init__(self, sft: SimpleFeatureType, shards: int = 4):
        super().__init__(sft, shards)
        self.sfc = Z2SFC()

    def write_keys(self, batch, fids, rows):
        col: GeometryColumn = batch.columns[self._geom()]
        zs = self.sfc.index(col.x, col.y)
        out = []
        for i in range(len(batch)):
            shard = _shard_of(fids[i], self.shards)
            key = (
                bytes([shard])
                + struct.pack(">Q", int(zs[i]))
                + fids[i].encode("utf-8")
            )
            out.append(WriteKey(key, rows[i]))
        return out

    def supports(self, f):
        bbox = extract_bbox(f, self._geom())
        return not bbox.is_whole_world and not bbox.is_empty

    def ranges(self, f, max_ranges=512):
        bbox = extract_bbox(f, self._geom())
        if bbox.is_empty:
            return []
        rs = self.sfc.ranges(
            bbox.xmin, bbox.ymin, bbox.xmax, bbox.ymax, max_ranges=max_ranges
        )
        inner = [
            (struct.pack(">Q", r.lower), struct.pack(">Q", r.upper + 1)) for r in rs
        ]
        return self._shard_ranges(inner)


class S2Index(IndexKeySpace):
    """S2-style cube-face keyspace (curve/s2.py): [shard][8B cellid][fid].

    Parity: the reference's S2 index variant (SURVEY.md:241-242 [L],
    geomesa s2 module over the sidx library) — deferred in rounds 1-2,
    built in round 3. Point geometries only (the reference's S2 index is
    likewise point-oriented; extended geometries keep XZ2/XZ3). Wins over
    Z2 for high-latitude workloads: cube faces bound cell-area distortion
    where Z2's lon/lat cells degenerate toward the poles."""

    name = "s2"

    def __init__(self, sft: SimpleFeatureType, shards: int = 4,
                 level: int = 15):
        super().__init__(sft, shards)
        from geomesa_tpu_torch.curve.s2 import S2SFC

        self.sfc = S2SFC(level)

    def write_keys(self, batch, fids, rows):
        col: GeometryColumn = batch.columns[self._geom()]
        cells = self.sfc.index(col.x, col.y)
        out = []
        for i in range(len(batch)):
            shard = _shard_of(fids[i], self.shards)
            key = (
                bytes([shard])
                + struct.pack(">Q", int(cells[i]))
                + fids[i].encode("utf-8")
            )
            out.append(WriteKey(key, rows[i]))
        return out

    def supports(self, f):
        bbox = extract_bbox(f, self._geom())
        return not bbox.is_whole_world and not bbox.is_empty

    def ranges(self, f, max_ranges=512):
        bbox = extract_bbox(f, self._geom())
        if bbox.is_empty:
            return []
        rs = self.sfc.ranges(
            bbox.xmin, bbox.ymin, bbox.xmax, bbox.ymax, max_ranges=max_ranges
        )
        inner = [
            (struct.pack(">Q", r.lower), struct.pack(">Q", r.upper + 1))
            for r in rs
        ]
        return self._shard_ranges(inner)


class XZ2Index(IndexKeySpace):
    name = "xz2"

    def __init__(self, sft: SimpleFeatureType, shards: int = 4, g: int = 12):
        super().__init__(sft, shards)
        self.sfc = XZ2SFC(g)

    def write_keys(self, batch, fids, rows):
        col: GeometryColumn = batch.columns[self._geom()]
        bbox = (
            col.bbox
            if not col.is_point
            else np.stack([col.x, col.y, col.x, col.y], axis=1)
        )
        out = []
        for i in range(len(batch)):
            xz = self.sfc.index(*(float(v) for v in bbox[i]))
            shard = _shard_of(fids[i], self.shards)
            key = (
                bytes([shard]) + struct.pack(">Q", xz) + fids[i].encode("utf-8")
            )
            out.append(WriteKey(key, rows[i]))
        return out

    def supports(self, f):
        bbox = extract_bbox(f, self._geom())
        return not bbox.is_whole_world and not bbox.is_empty

    def ranges(self, f, max_ranges=512):
        bbox = extract_bbox(f, self._geom())
        if bbox.is_empty:
            return []
        rs = self.sfc.ranges(
            bbox.xmin, bbox.ymin, bbox.xmax, bbox.ymax, max_ranges=max_ranges
        )
        inner = [
            (struct.pack(">Q", r.lower), struct.pack(">Q", r.upper + 1)) for r in rs
        ]
        return self._shard_ranges(inner)


class XZ3Index(IndexKeySpace):
    name = "xz3"

    def __init__(
        self,
        sft: SimpleFeatureType,
        shards: int = 4,
        g: int = 12,
        period: "str | TimePeriod" = TimePeriod.WEEK,
    ):
        super().__init__(sft, shards)
        self.sfc = XZ3SFC(period, g)

    def write_keys(self, batch, fids, rows):
        col: GeometryColumn = batch.columns[self._geom()]
        dtg = np.asarray(batch.columns[self._dtg()], np.int64)
        bbox = (
            col.bbox
            if not col.is_point
            else np.stack([col.x, col.y, col.x, col.y], axis=1)
        )
        out = []
        for i in range(len(batch)):
            b, xz = self.sfc.index(
                float(bbox[i][0]), float(bbox[i][1]),
                float(bbox[i][2]), float(bbox[i][3]), int(dtg[i]),
            )
            shard = _shard_of(fids[i], self.shards)
            key = (
                bytes([shard])
                + struct.pack(">H", int(b) & 0xFFFF)
                + struct.pack(">Q", xz)
                + fids[i].encode("utf-8")
            )
            out.append(WriteKey(key, rows[i]))
        return out

    def supports(self, f):
        # z3/xz3 need a fully bounded time range (upstream: the z3 index
        # requires a during/between-style interval; open-ended predicates
        # fall back to the spatial-only index or a full scan)
        interval = extract_intervals(f, self._dtg())
        return (
            interval.start is not None
            and interval.end is not None
            and not interval.is_empty
        )

    def ranges(self, f, max_ranges=512):
        bbox = extract_bbox(f, self._geom())
        interval = extract_intervals(f, self._dtg())
        if bbox.is_empty or interval.is_empty:
            return []
        per_bin = self.sfc.ranges(
            bbox.xmin, bbox.ymin, bbox.xmax, bbox.ymax,
            int(interval.start), int(interval.end),
            max_ranges=max_ranges,
        )
        inner = []
        for b, rs in per_bin.items():
            prefix = struct.pack(">H", int(b) & 0xFFFF)
            for r in rs:
                inner.append(
                    (prefix + struct.pack(">Q", r.lower),
                     prefix + struct.pack(">Q", r.upper + 1))
                )
        return self._shard_ranges(inner)


class IdIndex(IndexKeySpace):
    name = "id"

    def write_keys(self, batch, fids, rows):
        return [
            WriteKey(fids[i].encode("utf-8"), rows[i]) for i in range(len(batch))
        ]

    def supports(self, f):
        return _id_literals(f) is not None

    def ranges(self, f, max_ranges=512):
        ids = _id_literals(f)
        if ids is None:
            return []
        out = []
        for fid in ids:
            raw = fid.encode("utf-8")
            out.append((raw, raw + b"\x00"))
        return sorted(out)


def _id_literals(f: ast.Filter) -> Optional[List[str]]:
    """IN ('id1','id2') / = on the reserved __fid__ property -> literal ids.

    Parity: GeoTools Id filters (upstream `IN ('…')` bare-ID CQL). The CQL
    grammar here spells it as a predicate on the pseudo-attribute __fid__.
    """
    if isinstance(f, ast.In) and f.prop.name == "__fid__" and not f.negate:
        return [str(v) for v in f.values]
    if (
        isinstance(f, ast.Comparison)
        and f.op == "="
        and isinstance(f.left, ast.Property)
        and f.left.name == "__fid__"
        and isinstance(f.right, ast.Literal)
    ):
        return [str(f.right.value)]
    if isinstance(f, ast.And):
        for part in f.children:
            ids = _id_literals(part)
            if ids is not None:
                return ids
    return None


class AttributeIndex(IndexKeySpace):
    """Secondary index on one attribute, with a z3-tier suffix.

    Key = [2B attr index][lexicoded value][0x00][2B bin][8B z3 | zeros][fid].
    The tier suffix lets an `attr = v AND bbox/time` query narrow within the
    equality run (upstream's tiered attribute index).
    """

    name = "attr"

    def __init__(self, sft: SimpleFeatureType, attr: str, shards: int = 1):
        super().__init__(sft, shards)
        self.attr = attr
        self.attr_idx = sft.index_of(attr)
        self.type = sft.attribute(attr).type
        self._z3: Optional[Z3SFC] = None
        if sft.default_geometry is not None and sft.default_dtg is not None:
            if sft.default_geometry.type == "Point":
                self._z3 = Z3SFC()

    @property
    def full_name(self) -> str:
        return f"attr:{self.attr}"

    def _prefix(self) -> bytes:
        return struct.pack(">H", self.attr_idx)

    def _tier(self, batch: FeatureBatch) -> List[bytes]:
        n = len(batch)
        if self._z3 is None:
            return [b"\x00" * 10] * n
        col: GeometryColumn = batch.columns[self.sft.default_geometry.name]
        dtg = np.asarray(batch.columns[self.sft.default_dtg.name], np.int64)
        bins, zs = self._z3.index(col.x, col.y, dtg)
        return [
            struct.pack(">H", int(bins[i]) & 0xFFFF) + struct.pack(">Q", int(zs[i]))
            for i in range(n)
        ]

    def write_keys(self, batch, fids, rows):
        col = batch.columns[self.attr]
        values = col.decode() if isinstance(col, DictColumn) else np.asarray(col)
        tiers = self._tier(batch)
        out = []
        for i in range(len(batch)):
            enc = lx.encode_value(values[i], self.type)
            if enc is None:
                continue  # nulls are not indexed (upstream behavior)
            key = (
                self._prefix() + enc + lx.NULL_BYTE + tiers[i]
                + fids[i].encode("utf-8")
            )
            out.append(WriteKey(key, rows[i]))
        return out

    def _bounds(self, f: ast.Filter) -> Optional[List[Tuple[Optional[bytes], Optional[bytes], bool, bool]]]:
        """Extract (lo, hi, lo_incl, hi_incl) lexicoded bounds on self.attr.

        Returns None if the filter doesn't constrain the attribute. OR of
        equalities (IN) yields multiple bounds; AND intersects by keeping
        the first constraining clause (covering is still correct since the
        residual mask re-checks everything).
        """
        if isinstance(f, ast.And):
            for part in f.children:
                b = self._bounds(part)
                if b is not None:
                    return b
            return None
        if isinstance(f, ast.Or):
            parts = [self._bounds(p) for p in f.children]
            if any(p is None for p in parts):
                return None  # one branch unconstrained -> index can't cover OR
            return [b for p in parts for b in p]
        if isinstance(f, ast.In) and f.prop.name == self.attr and not f.negate:
            out = []
            for v in f.values:
                enc = lx.encode_value(v, self.type)
                if enc is not None:
                    out.append((enc, enc, True, True))
            return out
        if isinstance(f, ast.Between) and f.prop.name == self.attr and not f.negate:
            lo = lx.encode_value(f.lo.value, self.type)
            hi = lx.encode_value(f.hi.value, self.type)
            return [(lo, hi, True, True)]
        if isinstance(f, ast.Like) and f.prop.name == self.attr \
                and not f.negate and not f.case_insensitive:
            # prefix LIKE 'abc%' -> range scan on the literal prefix. Only
            # when the prefix is wildcard-free: '_' (single-char) and '\'
            # (escape) are LIKE metacharacters, and encoding them as literal
            # bytes would produce a non-covering range that drops matches.
            pat = f.pattern
            head = pat.rstrip("%")
            if (
                pat.endswith("%")
                and head
                and not any(c in head for c in ("%", "_", "\\"))
            ):
                prefix = lx.encode_string(head)
                return [(prefix, lx.successor(prefix), True, False)]
            return None
        if isinstance(f, ast.Comparison) and isinstance(f.left, ast.Property) \
                and f.left.name == self.attr and isinstance(f.right, ast.Literal):
            enc = lx.encode_value(f.right.value, self.type)
            if enc is None:
                return None
            if f.op == "=":
                return [(enc, enc, True, True)]
            if f.op in ("<", "<="):
                return [(None, enc, True, f.op == "<=")]
            if f.op in (">", ">="):
                return [(enc, None, f.op == ">=", True)]
        return None

    def supports(self, f):
        return self._bounds(f) is not None

    def ranges(self, f, max_ranges=512):
        bounds = self._bounds(f)
        if bounds is None:
            return []
        p = self._prefix()
        out = []
        for lo, hi, lo_incl, hi_incl in bounds:
            if lo is None:
                lo_key = p
            else:
                lo_key = p + lo + (lx.NULL_BYTE if lo_incl else b"\x01")
                if not lo_incl:
                    # strictly greater: skip the whole equality run of lo
                    lo_key = p + lx.successor(lo + lx.NULL_BYTE)
            if hi is None:
                hi_key = lx.successor(p)
            elif hi_incl:
                hi_key = p + lx.successor(hi + lx.NULL_BYTE)
            else:
                hi_key = p + hi + lx.NULL_BYTE
            out.append((lo_key, hi_key))
        return sorted(out)


def default_indices(
    sft: SimpleFeatureType, shards: int = 4
) -> List[IndexKeySpace]:
    """The reference's default index set for a schema (upstream
    GeoMesaFeatureIndexFactory behavior): z3 (point+dtg) or xz3
    (extended+dtg), z2/xz2 spatial-only, id always, plus an attribute index
    for every attribute flagged index=true in the spec."""
    out: List[IndexKeySpace] = [IdIndex(sft, shards=1)]
    g = sft.default_geometry
    d = sft.default_dtg
    if g is not None and g.type == "Point":
        out.append(Z2Index(sft, shards))
        if d is not None:
            out.append(Z3Index(sft, shards))
    elif g is not None:
        out.append(XZ2Index(sft, shards))
        if d is not None:
            out.append(XZ3Index(sft, shards))
    for a in sft.attributes:
        # "full" vs "join" (upstream: join indices store reduced columns and
        # join back to the record table) collapse to one behavior here: index
        # entries are (key, row-pointer) pairs and feature values live only
        # in the columnar record store, so every attribute index already has
        # join semantics with zero value duplication
        if a.options.get("index", "").lower() in ("true", "full", "join"):
            out.append(AttributeIndex(sft, a.name))
    return out
