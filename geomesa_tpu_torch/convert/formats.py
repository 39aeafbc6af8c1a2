"""Additional converter source formats: fixed-width, XML, shapefile, Avro.

A copy of the reference package's `convert/formats.py`, modelled on
geomesa-convert-fixedwidth / geomesa-convert-xml /
geomesa-convert-shp / geomesa-convert-avro [upstream, unverified].

- Fixed-width: fields declare (start, width) column slices; transforms see
  the slice as $0 and the whole line as $line.
- XML: one feature per element matched by `feature-path` (a simple
  tag/tag/tag path, no full XPath); fields use `path` relative to the
  feature element — child tag names, `@attr` attribute refs, and `tag/@attr`.
- Shapefile: a from-scratch reader of the public ESRI .shp/.dbf binary
  layout (point / polyline / polygon shapes); attributes come from the
  sibling .dbf (dBASE III) file.
- Avro: gated — no Avro library is a dependency; construction raises
  ImportError with a clear message, as the reference's does.
"""

from __future__ import annotations

import dataclasses
import io
import os
import struct
import xml.etree.ElementTree as ET
from typing import Dict, Iterator, List, Optional

import numpy as np

from geomesa_tpu_torch.convert.converter import _BaseConverter, _Field, _open
from geomesa_tpu_torch.convert.transforms import EvalContext, compile_expression
from geomesa_tpu_torch.core.columnar import FeatureBatch
from geomesa_tpu_torch.core.sft import SimpleFeatureType
from geomesa_tpu_torch.core.wkt import Geometry


class FixedWidthConverter(_BaseConverter):
    """Config fields add "start" and "width" (0-based character slices):

        {"type": "fixed-width",
         "fields": [{"name": "lat", "start": 0, "width": 6,
                     "transform": "$0::double"}, ...]}
    """

    def __init__(self, sft: SimpleFeatureType, config: dict):
        super().__init__(sft, config)
        self._slices = {}
        for f in config.get("fields", []):
            if "start" in f:
                self._slices[f["name"]] = (int(f["start"]), int(f["width"]))

    def _records(self, source):
        fh, close = _open(source)
        try:
            skip = int(self.config.get("options", {}).get("skip-lines", 0))
            for i, line in enumerate(fh):
                if i < skip:
                    continue
                line = line.rstrip("\n")
                if not line:
                    continue
                named = {}
                for name, (start, width) in self._slices.items():
                    named[name] = line[start : start + width].strip() or None
                yield EvalContext([line], named, line_no=i, raw=line)
        finally:
            if close:
                fh.close()

    def _field_value(self, ctx: EvalContext, f: _Field):
        v = ctx.named.get(f.name)
        if f.transform is not None:
            sub = EvalContext([v], ctx.named, ctx.line_no, ctx.raw)
            return f.transform(sub)
        return v


class XmlConverter(_BaseConverter):
    """Element-per-feature XML:

        {"type": "xml", "feature-path": "doc/row",
         "fields": [{"name": "name", "path": "props/name"},
                    {"name": "id", "path": "@id"}, ...]}
    """

    def __init__(self, sft: SimpleFeatureType, config: dict):
        super().__init__(sft, config)
        self.feature_path = config.get("feature-path", "")
        self._paths = {
            f["name"]: f["path"] for f in config.get("fields", []) if f.get("path")
        }

    def _records(self, source):
        fh, close = _open(source)
        try:
            root = ET.parse(fh).getroot()
        finally:
            if close:
                fh.close()
        parts = [p for p in self.feature_path.split("/") if p]
        # the root element itself may be the first path segment
        if parts and root.tag == parts[0]:
            parts = parts[1:]
        elements = root.iterfind("/".join(parts)) if parts else [root]
        for i, el in enumerate(elements):
            named = {
                name: _xml_extract(el, path) for name, path in self._paths.items()
            }
            yield EvalContext([el], named, line_no=i, raw=ET.tostring(el, "unicode"))

    def _field_value(self, ctx: EvalContext, f: _Field):
        v = ctx.named.get(f.name)
        if f.transform is not None:
            sub = EvalContext([v], ctx.named, ctx.line_no, ctx.raw)
            return f.transform(sub)
        return v


def _xml_extract(el: ET.Element, path: str) -> Optional[str]:
    if path.startswith("@"):
        return el.get(path[1:])
    if "/@" in path:
        sub, attr = path.rsplit("/@", 1)
        child = el.find(sub)
        return child.get(attr) if child is not None else None
    child = el.find(path)
    if child is None:
        return None
    return (child.text or "").strip() or None


# ---------------------------------------------------------------------------
# shapefile


_SHP_POINT = 1
_SHP_POLYLINE = 3
_SHP_POLYGON = 5


@dataclasses.dataclass
class ShapefileRecord:
    geometry: Geometry
    attributes: Dict[str, object]


def read_shapefile(path: str) -> Iterator[ShapefileRecord]:
    """Stream (geometry, attributes) from an ESRI shapefile pair
    (.shp + optional .dbf). Supports Point, PolyLine, Polygon."""
    base, _ = os.path.splitext(path)
    with open(base + ".shp", "rb") as f:
        shp = f.read()
    code, = struct.unpack(">i", shp[0:4])
    if code != 9994:
        raise ValueError(f"not a shapefile (magic {code})")
    dbf_rows = _read_dbf(base + ".dbf") if os.path.exists(base + ".dbf") else None
    off = 100
    i = 0
    while off + 8 <= len(shp):
        _, length_words = struct.unpack(">ii", shp[off : off + 8])
        content = shp[off + 8 : off + 8 + length_words * 2]
        off += 8 + length_words * 2
        if len(content) < 4:
            break
        (shape_type,) = struct.unpack("<i", content[0:4])
        geom = _parse_shape(shape_type, content)
        attrs = (
            dbf_rows[i]
            if dbf_rows is not None and i < len(dbf_rows) and dbf_rows[i] is not None
            else {}
        )
        if geom is not None:
            yield ShapefileRecord(geom, attrs)
        i += 1


def _parse_shape(shape_type: int, content: bytes) -> Optional[Geometry]:
    if shape_type == 0:  # null shape
        return None
    if shape_type == _SHP_POINT:
        x, y = struct.unpack_from("<dd", content, 4)
        return Geometry("Point", [np.array([[x, y]], np.float64)])
    if shape_type in (_SHP_POLYLINE, _SHP_POLYGON):
        num_parts, num_points = struct.unpack_from("<ii", content, 36)
        parts = list(struct.unpack_from(f"<{num_parts}i", content, 44))
        pts_off = 44 + 4 * num_parts
        flat = np.frombuffer(
            content, dtype="<f8", count=num_points * 2, offset=pts_off
        ).reshape(-1, 2)
        rings: List[np.ndarray] = []
        bounds = parts + [num_points]
        for p in range(num_parts):
            rings.append(np.array(flat[bounds[p] : bounds[p + 1]], np.float64))
        kind = "Polygon" if shape_type == _SHP_POLYGON else "LineString"
        if num_parts > 1 and shape_type == _SHP_POLYLINE:
            kind = "MultiLineString"
        return Geometry(kind, rings)
    raise NotImplementedError(f"shapefile shape type {shape_type}")


def _read_dbf(path: str) -> List[Dict[str, object]]:
    """dBASE III attribute table."""
    with open(path, "rb") as f:
        data = f.read()
    n_records, header_len, record_len = struct.unpack_from("<IHH", data, 4)
    fields = []
    off = 32
    while off < header_len - 1 and data[off] != 0x0D:
        raw_name = data[off : off + 11].split(b"\x00")[0].decode("ascii")
        ftype = chr(data[off + 11])
        flen = data[off + 16]
        fdec = data[off + 17]
        fields.append((raw_name, ftype, flen, fdec))
        off += 32
    rows = []
    off = header_len
    for _ in range(n_records):
        if off + record_len > len(data):
            break
        rec = data[off : off + record_len]
        off += record_len
        if rec[0:1] == b"*":  # deleted: keep a placeholder so .shp record
            rows.append(None)  # ordinals stay aligned with dbf ordinals
            continue
        row: Dict[str, object] = {}
        pos = 1
        for name, ftype, flen, fdec in fields:
            raw = rec[pos : pos + flen].decode("latin-1").strip()
            pos += flen
            if raw == "":
                row[name] = None
            elif ftype == "N":
                row[name] = float(raw) if fdec or "." in raw else int(raw)
            elif ftype == "F":
                row[name] = float(raw)
            elif ftype == "L":
                row[name] = raw.upper() in ("T", "Y")
            else:
                row[name] = raw
        rows.append(row)
    return rows


class ShapefileConverter:
    """Converter facade over read_shapefile: maps dbf columns (and the
    shape geometry) onto SFT attributes, with optional transforms taking
    the dbf value as $0."""

    def __init__(self, sft: SimpleFeatureType, config: dict):
        self.sft = sft
        self.config = config
        self.fields = {
            f["name"]: f for f in config.get("fields", [])
        }
        self.failed = 0

    def convert(self, path: str) -> FeatureBatch:
        data: Dict[str, list] = {a.name: [] for a in self.sft.attributes}
        fids: List[str] = []
        self.failed = 0
        geom_attr = self.sft.default_geometry
        for i, rec in enumerate(read_shapefile(path)):
            try:
                row: Dict[str, object] = {}
                for a in self.sft.attributes:
                    if geom_attr is not None and a.name == geom_attr.name:
                        row[a.name] = rec.geometry
                        continue
                    spec = self.fields.get(a.name, {})
                    src = spec.get("attribute", a.name)
                    v = rec.attributes.get(src)
                    if spec.get("transform"):
                        expr = compile_expression(spec["transform"])
                        v = expr(EvalContext([v], dict(rec.attributes), i, ""))
                    row[a.name] = v
                for a in self.sft.attributes:
                    if a.is_geometry and row.get(a.name) is None:
                        raise ValueError("no geometry")
                for a in self.sft.attributes:
                    data[a.name].append(row.get(a.name))
                fids.append(f"f{i}")
            except Exception:
                self.failed += 1
        return FeatureBatch.from_pydict(self.sft, data, fids=fids)


class AvroConverter:
    """Gated: no Avro library is a dependency of the package."""

    def __init__(self, sft: SimpleFeatureType, config: dict):
        raise ImportError(
            "Avro ingest requires an avro library (fastavro or avro-python3), "
            "which is not installed; convert to "
            "JSON/Parquet first or install a provider"
        )


# ---------------------------------------------------------------------------
# shapefile writing (export parity: the CLI's SHP export format)


def write_shapefile(path: str, batch: FeatureBatch) -> None:
    """Write points (+ dbf attributes) — the minimal export counterpart."""
    geom = batch.geometry
    if geom is None or not geom.is_point:
        raise NotImplementedError("shapefile export supports point layers")
    base, _ = os.path.splitext(path)
    n = len(batch)
    # .shp
    rec_len_words = (8 + 20) // 2  # header + point content, in 16-bit words
    file_words = (100 + n * (8 + 20)) // 2
    with open(base + ".shp", "wb") as f:
        _shp_header(f, file_words, geom)
        for i in range(n):
            f.write(struct.pack(">ii", i + 1, 10))
            f.write(struct.pack("<idd", _SHP_POINT, float(geom.x[i]), float(geom.y[i])))
    # .shx
    with open(base + ".shx", "wb") as f:
        _shp_header(f, (100 + n * 8) // 2, geom)
        for i in range(n):
            f.write(struct.pack(">ii", (100 + i * 28) // 2, 10))
    # .dbf
    _write_dbf(base + ".dbf", batch)


def _shp_header(f, file_words: int, geom) -> None:
    f.write(struct.pack(">i", 9994))
    f.write(b"\x00" * 20)
    f.write(struct.pack(">i", file_words))
    f.write(struct.pack("<ii", 1000, _SHP_POINT))
    xmin, ymin = float(np.min(geom.x)), float(np.min(geom.y))
    xmax, ymax = float(np.max(geom.x)), float(np.max(geom.y))
    f.write(struct.pack("<dddd", xmin, ymin, xmax, ymax))
    f.write(struct.pack("<dddd", 0, 0, 0, 0))


def _write_dbf(path: str, batch: FeatureBatch) -> None:
    from geomesa_tpu_torch.core.columnar import DictColumn

    cols = []
    for a in batch.sft.attributes:
        if a.is_geometry:
            continue
        col = batch.columns[a.name]
        if isinstance(col, DictColumn):
            vals = ["" if v is None else str(v) for v in col.decode()]
            width = max(1, min(254, max((len(v) for v in vals), default=1)))
            cols.append((a.name[:10], "C", width, 0, vals))
        else:
            arr = np.asarray(col)
            dec = 6 if arr.dtype.kind == "f" else 0
            if dec:
                # render first, size the field after: fixed-point when it
                # fits the 32-char N cap AND preserves the value; else
                # %.10g (≤17 chars, always fits; dbf readers parse either)
                def fmt(x: float) -> str:
                    s = f"{x:.6f}"
                    if len(s) > 32 or (
                        x != 0.0 and abs(float(s) - x) > 1e-9 * abs(x)
                    ):
                        s = f"{x:.10g}"
                    return s

                vals = [fmt(float(v)) for v in arr.tolist()]
            else:
                vals = [str(v) for v in arr.tolist()]
            width = max(1, min(32, max((len(v) for v in vals), default=1)))
            cols.append((a.name[:10], "N", width, dec, vals))
    n = len(batch)
    record_len = 1 + sum(w for _, _, w, _, _ in cols)
    header_len = 32 + 32 * len(cols) + 1
    with open(path, "wb") as f:
        f.write(struct.pack("<BBBBIHH", 3, 95, 7, 26, n, header_len, record_len))
        f.write(b"\x00" * 20)
        for name, ftype, width, dec, _ in cols:
            f.write(name.encode("ascii").ljust(11, b"\x00"))
            f.write(ftype.encode("ascii"))
            f.write(b"\x00" * 4)
            f.write(struct.pack("<BB", width, dec))
            f.write(b"\x00" * 14)
        f.write(b"\x0d")
        for i in range(n):
            f.write(b" ")
            for _, ftype, width, _, vals in cols:
                v = vals[i][:width]
                f.write(v.rjust(width).encode("latin-1") if ftype == "N"
                        else v.ljust(width).encode("latin-1"))
        f.write(b"\x1a")


class ParquetConverter(_BaseConverter):
    """Parquet input (upstream: geomesa-convert parquet input [L]).
    Fields address source columns by `path` (column
    name) or positionally ($1..$N in schema order); transforms apply on
    top as usual. Reads row-group batches columnar-side and only then
    iterates rows, so the per-record Python work is dict assembly, not
    parquet decoding."""

    def _records(self, source):
        import pyarrow.parquet as papq

        pf = papq.ParquetFile(source)
        names = pf.schema_arrow.names
        line = 0
        for rb in pf.iter_batches():
            cols = [c.to_pylist() for c in rb.columns]
            for i in range(rb.num_rows):
                line += 1
                row = {n: cols[j][i] for j, n in enumerate(names)}
                yield EvalContext(
                    positional=[row] + [cols[j][i] for j in range(len(names))],
                    named=dict(row),
                    line_no=line,
                )

    def _field_value(self, ctx, f):
        return _columnar_field_value(self, ctx, f)


class JdbcConverter(_BaseConverter):
    """JDBC-style input over a SQL database (upstream: geomesa-convert
    JDBC [L]). The config carries the query; the SOURCE is a DB-API
    connection or a SQLite path (the zero-dependency stand-in for the
    reference's JDBC URL). Columns address by name (`path`) or position.

        {"type": "jdbc", "query": "SELECT id, lon, lat FROM obs", ...}
    """

    def _records(self, source):
        import sqlite3

        close = False
        if isinstance(source, (str, bytes)):
            conn = sqlite3.connect(source)
            close = True
        else:
            conn = source
        try:
            cur = conn.cursor()
            cur.execute(self.config["query"])
            names = [d[0] for d in cur.description]
            for line, rec in enumerate(cur, 1):
                row = dict(zip(names, rec))
                yield EvalContext(
                    positional=[row] + list(rec),
                    named=row,
                    line_no=line,
                )
        finally:
            if close:
                conn.close()

    def _field_value(self, ctx, f):
        return _columnar_field_value(self, ctx, f)


def _columnar_field_value(conv: _BaseConverter, ctx: EvalContext, f: _Field):
    """Shared by the columnar-source converters (parquet/jdbc): `path`
    addresses a source column by name (nested struct/list segments use the
    same _extract rules as the JSON converter); transforms see $0 = that
    value."""
    from geomesa_tpu_torch.convert.converter import _extract

    if f.path is not None:
        v = _extract(ctx.named, f.path)
        if f.transform is not None:
            return f.transform(EvalContext([v], dict(ctx.named), ctx.line_no))
        return v
    return _BaseConverter._field_value(conv, ctx, f)
