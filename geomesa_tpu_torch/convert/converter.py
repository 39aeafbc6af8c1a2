"""SimpleFeatureConverter implementations: delimited text and JSON.

A copy of the reference package's `convert/converter.py`, modelled on
geomesa-convert-text / geomesa-convert-json [upstream, unverified].
Config shape (the TypeSafe-Config structure as a plain dict):

    {
      "type": "delimited-text",        # or "json"
      "format": "CSV",                 # CSV | TSV (delimited-text)
      "options": {"skip-lines": 1, "error-mode": "skip-bad-records"},
      "id-field": "md5($2)",           # transform expr for the feature id
      "fields": [
        {"name": "eventId", "transform": "$1::int"},
        {"name": "geom", "transform": "point($40, $39)"},
      ],
    }

$0 is the whole record; $N is the 1-based source column (upstream
convention). For JSON, fields use "path" ($.a.b) plus optional transform
over $0 (= the extracted path value).

Validation parity: records whose geometry/dtg fail to materialize are
dropped ("skip-bad-records", the default) or raise ("raise-errors").
"""

from __future__ import annotations

import csv
import dataclasses
import io
import json
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from geomesa_tpu_torch.core.columnar import FeatureBatch
from geomesa_tpu_torch.core.sft import SimpleFeatureType
from geomesa_tpu_torch.core.wkt import Geometry
from geomesa_tpu_torch.convert.transforms import EvalContext, compile_expression


@dataclasses.dataclass
class _Field:
    name: str
    transform: Optional[object]  # compiled expr
    path: Optional[List[str]] = None  # json path segments


class _BaseConverter:
    def __init__(self, sft: SimpleFeatureType, config: dict):
        self.sft = sft
        self.config = config
        self.error_mode = config.get("options", {}).get(
            "error-mode", "skip-bad-records"
        )
        self.id_field = (
            compile_expression(config["id-field"]) if config.get("id-field") else None
        )
        self.fields: List[_Field] = []
        for f in config.get("fields", []):
            self.fields.append(
                _Field(
                    f["name"],
                    compile_expression(f["transform"]) if f.get("transform") else None,
                    _json_path(f["path"]) if f.get("path") else None,
                )
            )
        self.failed = 0

    def _records(self, source) -> Iterable[EvalContext]:
        raise NotImplementedError

    def _field_value(self, ctx: EvalContext, f: _Field):
        if f.transform is not None:
            return f.transform(ctx)
        return ctx.named.get(f.name)

    def convert(self, source) -> FeatureBatch:
        """Parse a source (file path / file obj / string) into a batch."""
        data: Dict[str, list] = {a.name: [] for a in self.sft.attributes}
        fids: List[str] = []
        self.failed = 0
        for ctx in self._records(source):
            try:
                row = {}
                for f in self.fields:
                    row[f.name] = self._field_value(ctx, f)
                    ctx.named[f.name] = row[f.name]
                fid = str(self.id_field(ctx)) if self.id_field else f"f{ctx.line_no}"
                # validate the whole row BEFORE any append so a skipped
                # record never leaves columns misaligned
                for a in self.sft.attributes:
                    v = row.get(a.name)
                    if a.is_geometry and v is None:
                        raise ValueError(f"no geometry for {a.name}")
                    if a.is_temporal and v is None:
                        raise ValueError(f"no date for {a.name}")
                for a in self.sft.attributes:
                    data[a.name].append(row.get(a.name))
                fids.append(fid)
            except Exception:
                if self.error_mode == "raise-errors":
                    raise
                self.failed += 1
        from geomesa_tpu_torch.utils.metrics import metrics

        metrics.counter("convert.success", len(fids))
        metrics.counter("convert.failure", self.failed)
        return self._to_batch(data, fids)

    def _to_batch(self, data, fids) -> FeatureBatch:
        cols = {}
        for a in self.sft.attributes:
            vals = data[a.name]
            if a.is_geometry:
                if vals and isinstance(vals[0], tuple):
                    arr = np.asarray(vals, np.float64)
                    cols[a.name] = arr
                else:
                    cols[a.name] = vals  # Geometry objects / WKT
            else:
                cols[a.name] = vals
        return FeatureBatch.from_pydict(self.sft, cols, fids=fids)


class DelimitedTextConverter(_BaseConverter):
    def _records(self, source):
        fh, close = _open(source)
        try:
            delim = "\t" if self.config.get("format", "CSV").upper() == "TSV" else ","
            skip = int(self.config.get("options", {}).get("skip-lines", 0))
            reader = csv.reader(fh, delimiter=delim)
            for i, rec in enumerate(reader):
                if i < skip:
                    continue
                raw = delim.join(rec)
                # $0 = full record, $N = 1-based column (upstream convention)
                yield EvalContext([raw] + rec, {}, line_no=i, raw=raw)
        finally:
            if close:
                fh.close()


class JsonConverter(_BaseConverter):
    def _records(self, source):
        fh, close = _open(source)
        try:
            for i, line in enumerate(fh):
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)
                named = {}
                for f in self.fields:
                    if f.path is not None:
                        named[f.name] = _extract(obj, f.path)
                yield EvalContext([obj], named, line_no=i, raw=line)
        finally:
            if close:
                fh.close()

    def _field_value(self, ctx: EvalContext, f: _Field):
        # transforms run over the extracted path value, exposed as $0; a
        # missing path stays None so e.g. withDefault($0, ...) sees null
        # rather than the whole record
        v = ctx.named.get(f.name)
        if f.transform is not None:
            sub = EvalContext([v], ctx.named, ctx.line_no, ctx.raw)
            v = f.transform(sub)
        return v


def _open(source):
    if hasattr(source, "read"):
        return source, False
    if isinstance(source, str) and "\n" in source:
        return io.StringIO(source), True  # inline data
    # anything else is a path; a missing file must fail loudly, never be
    # silently parsed as inline data
    return open(source, "r"), True


def _json_path(path: str) -> List[str]:
    if path.startswith("$."):
        path = path[2:]
    elif path.startswith("$"):
        path = path[1:]
    return [p for p in path.split(".") if p]


def _extract(obj, path: List[str]):
    cur = obj
    for p in path:
        if isinstance(cur, dict):
            cur = cur.get(p)
        elif isinstance(cur, list) and p.isdigit():
            cur = cur[int(p)] if int(p) < len(cur) else None
        else:
            return None
        if cur is None:
            return None
    return cur


def converter_from_config(sft: SimpleFeatureType, config: dict):
    kind = config.get("type", "delimited-text")
    if kind == "delimited-text":
        return DelimitedTextConverter(sft, config)
    if kind == "json":
        return JsonConverter(sft, config)
    if kind in ("fixed-width", "xml", "shp", "avro", "parquet", "jdbc"):
        from geomesa_tpu_torch.convert import formats

        cls = {
            "fixed-width": formats.FixedWidthConverter,
            "xml": formats.XmlConverter,
            "shp": formats.ShapefileConverter,
            "avro": formats.AvroConverter,
            "parquet": formats.ParquetConverter,
            "jdbc": formats.JdbcConverter,
        }[kind]
        return cls(sft, config)
    raise ValueError(f"unknown converter type {kind!r}")
