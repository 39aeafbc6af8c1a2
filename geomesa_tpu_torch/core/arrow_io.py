"""Arrow interop: FeatureBatch <-> pyarrow RecordBatch / IPC streams.

The counterpart of the reference package's `core/arrow_io.py`, copied
(upstream: geomesa-arrow's SimpleFeatureVector and its IPC writer and
reader): the SFT <-> Arrow schema mapping with dictionary-encoded
strings and timestamp-millis dates, the ArrowScan result encoding, the
sorted DELTA batches and their client-side merge.

Schema mapping:
  String/UUID -> dictionary<int32, utf8>
  Integer     -> int32        Long -> int64
  Double      -> float64      Float -> float32
  Boolean     -> bool_        Date/Timestamp -> timestamp('ms', 'UTC')
  Point geom  -> struct{x: float64, y: float64}
  other geoms -> utf8 WKT (lossless; CSR reconstruction on read)
Feature ids  -> dictionary column "__fid__" when present.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np
import pyarrow as pa

from geomesa_tpu_torch.core.columnar import DictColumn, FeatureBatch, GeometryColumn
from geomesa_tpu_torch.core.sft import SimpleFeatureType
from geomesa_tpu_torch.core.wkt import parse_wkt, to_wkt

FID = "__fid__"

_ARROW_TYPES = {
    "Integer": pa.int32(),
    "Long": pa.int64(),
    "Double": pa.float64(),
    "Float": pa.float32(),
    "Boolean": pa.bool_(),
    "Bytes": pa.binary(),
}


def _dict_to_arrow(col: DictColumn) -> pa.DictionaryArray:
    codes = np.asarray(col.codes, dtype=np.int64)
    return pa.DictionaryArray.from_arrays(
        pa.array(codes, pa.int32(), mask=codes < 0), pa.array(col.vocab, pa.string())
    )


def arrow_schema(sft: SimpleFeatureType, include_fid: bool = True) -> pa.Schema:
    fields: List[pa.Field] = []
    for a in sft.attributes:
        if a.is_geometry:
            if a.type == "Point":
                t = pa.struct([("x", pa.float64()), ("y", pa.float64())])
            else:
                t = pa.string()
        elif a.type in ("String", "UUID"):
            t = pa.dictionary(pa.int32(), pa.string())
        elif a.is_temporal:
            t = pa.timestamp("ms", tz="UTC")
        elif a.type in _ARROW_TYPES:
            t = _ARROW_TYPES[a.type]
        else:
            raise NotImplementedError(
                f"attribute type {a.type!r} has no Arrow mapping yet"
            )
        fields.append(pa.field(a.name, t))
    if include_fid:
        fields.append(pa.field(FID, pa.dictionary(pa.int32(), pa.string())))
    return pa.schema(fields, metadata={b"geomesa.sft.name": sft.name.encode(),
                                       b"geomesa.sft.spec": sft.to_spec().encode()})


def to_arrow(batch: FeatureBatch,
             schema: Optional[pa.Schema] = None) -> pa.RecordBatch:
    # Padding is a transient device-shape concern, not a persistence concern:
    # compact to valid rows so no fabricated features reach the wire.
    if batch.valid is not None and not batch.valid.all():
        batch = batch.select(batch.valid)
    arrays: List[pa.Array] = []
    # `schema` lets hot callers (the columnar wire's per-typeName cache)
    # skip re-deriving it per batch; it must match the derived one
    if schema is None:
        schema = arrow_schema(batch.sft, include_fid=batch.fids is not None)
    for a in batch.sft.attributes:
        col = batch.columns[a.name]
        if isinstance(col, GeometryColumn):
            if col.is_point:
                arrays.append(
                    pa.StructArray.from_arrays(
                        [pa.array(col.x, pa.float64()), pa.array(col.y, pa.float64())],
                        names=["x", "y"],
                    )
                )
            else:
                arrays.append(
                    pa.array([to_wkt(col.geometry(i)) for i in range(len(col))])
                )
        elif isinstance(col, DictColumn):
            arrays.append(_dict_to_arrow(col))
        elif a.is_temporal:
            arrays.append(pa.array(col, pa.timestamp("ms", tz="UTC")))
        elif a.type == "Bytes":
            arrays.append(pa.array(list(col), pa.binary()))
        else:
            arrays.append(pa.array(col))
    if batch.fids is not None:
        arrays.append(_dict_to_arrow(batch.fids))
    return pa.RecordBatch.from_arrays(arrays, schema=schema)


def from_arrow(rb: pa.RecordBatch, sft: Optional[SimpleFeatureType] = None) -> FeatureBatch:
    if sft is None:
        meta = rb.schema.metadata or {}
        spec = meta.get(b"geomesa.sft.spec")
        name = meta.get(b"geomesa.sft.name", b"features")
        if spec is None:
            raise ValueError("record batch has no geomesa.sft.spec metadata")
        sft = SimpleFeatureType.from_spec(name.decode(), spec.decode())
    cols = {}
    for a in sft.attributes:
        arr = rb.column(rb.schema.get_field_index(a.name))
        if a.is_geometry:
            if a.type == "Point" and pa.types.is_struct(arr.type):
                x = arr.field("x").to_numpy(zero_copy_only=False)
                y = arr.field("y").to_numpy(zero_copy_only=False)
                cols[a.name] = GeometryColumn.from_points(x, y)
            else:
                geoms = [parse_wkt(w) for w in arr.to_pylist()]
                cols[a.name] = GeometryColumn.from_geometries(geoms)
        elif a.type in ("String", "UUID"):
            cols[a.name] = _dict_from_arrow(arr)
        elif a.is_temporal:
            cols[a.name] = arr.cast(pa.int64()).to_numpy(zero_copy_only=False)
        else:
            cols[a.name] = arr.to_numpy(zero_copy_only=False)
    fids = None
    if FID in rb.schema.names:
        fids = _dict_from_arrow(rb.column(rb.schema.get_field_index(FID)))
    return FeatureBatch(sft, cols, fids)


def _dict_from_arrow(arr: pa.Array) -> DictColumn:
    if pa.types.is_dictionary(arr.type):
        codes = arr.indices.to_numpy(zero_copy_only=False)
        codes = np.where(np.isnan(codes), -1, codes).astype(np.int32) if codes.dtype.kind == "f" else codes.astype(np.int32)
        vocab = arr.dictionary.to_pylist()
        return DictColumn(codes, vocab)
    return DictColumn.encode(arr.to_pylist())


def to_ipc_bytes(batch: FeatureBatch) -> bytes:
    """One FeatureBatch as Arrow IPC stream bytes (the ArrowScan result
    encoding; shard/partition results merge via merge_record_batches)."""
    import io

    rb = to_arrow(batch)
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, rb.schema) as writer:
        writer.write_batch(rb)
    return sink.getvalue()


SORT_FIELD_META = b"geomesa.sort.field"
SORT_REVERSE_META = b"geomesa.sort.reverse"


def _sort_key_np(batch: FeatureBatch, field: str) -> np.ndarray:
    col = batch.columns[field]
    if isinstance(col, DictColumn):
        return np.array(["" if v is None else v for v in col.decode()])
    if isinstance(col, GeometryColumn):
        raise ValueError("cannot sort arrow deltas by a geometry column")
    return np.asarray(col)


def to_sorted_ipc_bytes(
    batch: FeatureBatch, sort_field: str, reverse: bool = False
) -> bytes:
    """One shard's ArrowScan DELTA batch: rows pre-sorted by `sort_field`,
    sort recorded in the schema metadata so the client merge can verify
    and exploit it (upstream: ArrowScan's pre-sorted delta batches merged
    by DeltaWriter)."""
    import io

    key = _sort_key_np(batch, sort_field)
    order = np.argsort(key, kind="stable")
    if reverse:
        order = order[::-1]
    rb = to_arrow(batch.select(order))
    meta = dict(rb.schema.metadata or {})
    meta[SORT_FIELD_META] = sort_field.encode()
    meta[SORT_REVERSE_META] = b"1" if reverse else b"0"
    schema = rb.schema.with_metadata(meta)
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, schema) as writer:
        writer.write_batch(rb)
    return sink.getvalue()


def merge_sorted_ipc(streams: List[bytes]) -> bytes:
    """Client-side DeltaWriter merge: combine per-shard sorted delta
    streams into ONE globally sorted IPC stream. Dictionaries are re-keyed
    into a shared vocabulary first (merge_record_batches); the final order
    comes from a stable mergesort over the concatenated key column, which
    runs near-linear on the pre-sorted runs the shards provide — the
    k-way-merge economics of the reference without custom heap code."""
    import io

    rbs: List[pa.RecordBatch] = []
    field: Optional[str] = None
    reverse = False
    for s in streams:
        reader = pa.ipc.open_stream(io.BytesIO(s))
        meta = reader.schema.metadata or {}
        f = meta.get(SORT_FIELD_META)
        if f is None:
            raise ValueError("stream is not a sorted delta (no sort metadata)")
        f = f.decode()
        r = meta.get(SORT_REVERSE_META, b"0") == b"1"
        if field is None:
            field, reverse = f, r
        elif (field, reverse) != (f, r):
            raise ValueError(
                f"delta sort mismatch: {field!r}/{reverse} vs {f!r}/{r}"
            )
        rbs.extend(reader)
    if field is None:
        raise ValueError("no delta streams to merge")
    rbs = [rb for rb in rbs if rb.num_rows]
    sink = io.BytesIO()
    if not rbs:
        # schema-only stream (all shards empty)
        reader = pa.ipc.open_stream(io.BytesIO(streams[0]))
        with pa.ipc.new_stream(sink, reader.schema):
            pass
        return sink.getvalue()
    merged = merge_record_batches(rbs)
    col = merged.column(field)
    if pa.types.is_dictionary(col.type):
        key = np.array(
            ["" if v is None else v for v in col.to_pylist()]
        )
    else:
        key = col.to_numpy(zero_copy_only=False)
    order = np.argsort(key, kind="stable")  # timsort: merges sorted runs
    if reverse:
        order = order[::-1]
    merged = merged.take(pa.array(order))
    meta = dict(merged.schema.metadata or {})
    meta[SORT_FIELD_META] = field.encode()
    meta[SORT_REVERSE_META] = b"1" if reverse else b"0"
    schema = merged.schema.with_metadata(meta)
    with pa.ipc.new_stream(sink, schema) as writer:
        writer.write_batch(
            pa.record_batch(merged.columns, schema=schema)
        )
    return sink.getvalue()


def ipc_feature_batches(
    payload: bytes, sft: Optional[SimpleFeatureType] = None
) -> Iterable[FeatureBatch]:
    """FeatureBatches decoded from one Arrow IPC stream (the columnar
    wire's bulk-ingest payload). Numeric and point-geometry columns
    come out as NumPy views over the IPC buffers where pyarrow allows
    zero-copy — no per-feature Python objects on the ingest path."""
    import io

    reader = pa.ipc.open_stream(io.BytesIO(payload))
    for rb in reader:
        yield from_arrow(rb, sft)


def write_ipc(path: str, batches: Iterable[FeatureBatch]) -> None:
    batches = list(batches)
    if not batches:
        raise ValueError("no batches")
    schema = arrow_schema(batches[0].sft, include_fid=batches[0].fids is not None)
    with pa.OSFile(path, "wb") as f:
        with pa.ipc.new_stream(f, schema) as writer:
            for b in batches:
                writer.write_batch(to_arrow(b))


def read_ipc(path: str) -> List[FeatureBatch]:
    with pa.OSFile(path, "rb") as f:
        reader = pa.ipc.open_stream(f)
        meta = reader.schema.metadata or {}
        sft = None
        if b"geomesa.sft.spec" in meta:
            sft = SimpleFeatureType.from_spec(
                meta.get(b"geomesa.sft.name", b"features").decode(),
                meta[b"geomesa.sft.spec"].decode(),
            )
        return [from_arrow(rb, sft) for rb in reader]


def merge_record_batches(batches: "List[pa.RecordBatch]") -> pa.RecordBatch:
    """Merge per-shard Arrow result batches into one, unifying dictionary
    columns whose vocabularies differ across shards.

    Upstream: the client-side delta/dictionary merge of a distributed
    ArrowScan: each shard emits batches with its own dictionary; the
    reducer re-keys codes into one shared vocabulary. Raises on schema-shape mismatch (same guarantee as the
    reference: all deltas come from one query's transform schema).
    """
    if not batches:
        raise ValueError("no batches to merge")
    if len(batches) == 1:
        return batches[0]
    names = batches[0].schema.names
    for rb in batches[1:]:
        if rb.schema.names != names:
            raise ValueError(
                f"schema mismatch: {rb.schema.names} vs {names}"
            )
    # pa.unify_schemas + concat_tables(promote) handles dictionary
    # re-keying; cast back to one record batch
    table = pa.concat_tables(
        [pa.Table.from_batches([rb]) for rb in batches],
        promote_options="permissive",
    ).combine_chunks()
    out = table.to_batches()
    if len(out) != 1:  # combine_chunks guarantees one chunk per column
        out = [pa.concat_batches(out)] if hasattr(pa, "concat_batches") else out
    return out[0]
